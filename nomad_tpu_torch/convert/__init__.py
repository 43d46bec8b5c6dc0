"""Weight conversion between the JAX package's flat params and the port's
state_dict, both ways: NOMAD's model and the SE demo's Wave-U-Net."""

from .from_jax import jax_to_state_dict
from .to_jax import jax_name, state_dict_to_jax
from .waveunet import jax_to_waveunet, waveunet_to_jax

__all__ = ["jax_name", "jax_to_state_dict", "jax_to_waveunet", "state_dict_to_jax",
           "waveunet_to_jax"]
