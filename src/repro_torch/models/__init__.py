"""Dense decoder models of the port: config, layers, attention, composition
and conversion of the JAX package's parameters."""
