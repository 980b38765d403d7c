from .convert import dit_state_dict_from_jax
from .dit import AdaLNZero, DiT, DiTConfig, JointBlock, timestep_embedding
from .integration import layered_attention, sage_dot_product_attention, sage_joint_attention_ragged

__all__ = ["AdaLNZero", "DiT", "DiTConfig", "JointBlock",
           "timestep_embedding", "sage_dot_product_attention",
           "sage_joint_attention_ragged", "layered_attention",
           "dit_state_dict_from_jax"]
