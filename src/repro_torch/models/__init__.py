"""The LM stack of the port: the dense decoder LM (``model``), its layers
(``layers``), the config (``config``) and the JAX parameter bridge
(``convert``)."""
