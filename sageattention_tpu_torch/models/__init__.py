from .convert import dit_state_dict_from_jax, llm_state_dict_from_jax
from .dit import (AdaLNZero, DiT, DiTConfig, JointBlock, diffusion_loss, example_inputs,
                  make_dit, timestep_embedding)
from .integration import (flash_dot_product_attention, layered_attention,
                          sage_dot_product_attention, sage_joint_attention_ragged)
from .llm import LlamaBlock, LlamaConfig, LlamaLM

__all__ = ["AdaLNZero", "DiT", "DiTConfig", "JointBlock", "make_dit", "example_inputs",
           "diffusion_loss",
           "timestep_embedding", "sage_dot_product_attention",
           "sage_joint_attention_ragged", "layered_attention", "flash_dot_product_attention",
           "dit_state_dict_from_jax", "llm_state_dict_from_jax", "LlamaBlock", "LlamaConfig",
           "LlamaLM"]
