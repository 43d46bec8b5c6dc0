"""Weight conversion into the port's state_dict."""

from .from_jax import jax_to_state_dict

__all__ = ["jax_to_state_dict"]
