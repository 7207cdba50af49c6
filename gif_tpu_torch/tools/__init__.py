"""Weight conversion from the JAX package (``convert_params``: generator,
discriminator, train state and the FID InceptionV3)."""
