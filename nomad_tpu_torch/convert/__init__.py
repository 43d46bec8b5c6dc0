"""Weight conversion: the JAX package's flat params <-> the port's
state_dict, both ways (NOMAD's model and the SE demo's Wave-U-Net), and
fairseq/NOMAD/HF torch checkpoints -> the port's state_dict."""

from .from_fairseq import canonicalize, convert_checkpoint, fairseq_to_state_dict
from .from_fairseq import load_torch_checkpoint, merge_into
from .from_jax import jax_to_state_dict
from .to_jax import jax_name, state_dict_to_jax
from .waveunet import jax_to_waveunet, waveunet_to_jax

__all__ = ["canonicalize", "convert_checkpoint", "fairseq_to_state_dict", "jax_name",
           "jax_to_state_dict", "jax_to_waveunet", "load_torch_checkpoint", "merge_into",
           "state_dict_to_jax", "waveunet_to_jax"]
