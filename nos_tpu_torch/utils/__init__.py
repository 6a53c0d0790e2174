"""Host- and device-side helpers of the port that the reference keeps in
JAX itself (``jax.random``)."""
