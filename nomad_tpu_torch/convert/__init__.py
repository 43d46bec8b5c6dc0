"""Weight conversion between the JAX package's flat params and the port's
state_dict, both ways."""

from .from_jax import jax_to_state_dict
from .to_jax import jax_name, state_dict_to_jax

__all__ = ["jax_name", "jax_to_state_dict", "state_dict_to_jax"]
