"""Weights from the JAX package's flax models to the port's.

``dit_state_dict_from_jax(params)`` and ``llm_state_dict_from_jax(params)``
take the flax parameter tree (nested dicts of numpy arrays, with or without
the top-level ``"params"`` key) and return a ``state_dict`` for
:class:`~sageattention_tpu_torch.models.dit.DiT` or
:class:`~sageattention_tpu_torch.models.llm.LlamaLM`: a ``Dense.kernel`` of
shape [in, out] becomes ``Linear.weight`` [out, in]; biases, norm scales,
embeddings and ``pos_emb`` carry across unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

# flax module names -> the port's, inside a JointBlock and at the top
_BLOCK_MODULES = {"AdaLNZero_0/Dense_0": "ada.linear", "qkv": "qkv", "proj": "proj",
                  "Dense_0": "fc1", "Dense_1": "fc2"}
_TOP_MODULES = {"patch_embed", "text_embed", "t_embed", "t_embed2", "final",
                "LayerNorm_0"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def dit_state_dict_from_jax(params) -> dict:
    if "params" in params:
        params = params["params"]
    out = {}
    for path, val in _flatten(params):
        arr = np.asarray(val, dtype=np.float32)
        leaf = path[-1]
        if path == ("pos_emb",):
            out["pos_emb"] = torch.tensor(arr)
            continue
        if path[0].startswith("block_"):
            mod = _BLOCK_MODULES["/".join(path[1:-1])]
            name = f"blocks.{int(path[0][len('block_'):])}.{mod}"
        elif path[0] in _TOP_MODULES and len(path) == 2:
            name = "final_norm" if path[0] == "LayerNorm_0" else path[0]
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        if leaf == "kernel":
            arr = arr.T
        out[f"{name}.{_LEAVES[leaf]}"] = torch.tensor(arr)
    return out


# flax module names of a LlamaBlock -> the port's
_LLM_BLOCK_MODULES = {"RMSNorm_0": "attn_norm", "RMSNorm_1": "mlp_norm", "wq": "wq", "wk": "wk",
                      "wv": "wv", "wo": "wo", "Dense_0": "gate", "Dense_1": "up",
                      "Dense_2": "down"}


def llm_state_dict_from_jax(params) -> dict:
    """``LlamaLM.state_dict()`` from the flax tree: ``Embed_0``,
    ``layer_i/{RMSNorm_0, RMSNorm_1, wq, wk, wv, wo, Dense_0, Dense_1,
    Dense_2}``, ``RMSNorm_0`` (the final norm) and ``lm_head``."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, val in _flatten(params):
        arr = np.asarray(val, dtype=np.float32)
        if path == ("Embed_0", "embedding"):
            name = "embed.weight"
        elif path == ("RMSNorm_0", "scale"):
            name = "norm.weight"
        elif path == ("lm_head", "kernel"):
            name = "lm_head.weight"
        elif path[0].startswith("layer_") and len(path) == 3 and path[1] in _LLM_BLOCK_MODULES:
            name = f"layers.{int(path[0][len('layer_'):])}.{_LLM_BLOCK_MODULES[path[1]]}.weight"
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        if path[-1] == "kernel":
            arr = arr.T
        out[name] = torch.tensor(arr)
    return out
