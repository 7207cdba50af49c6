"""Weight conversion from the JAX package (``convert_params``)."""
