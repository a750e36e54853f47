"""The LM stack of the port: the decoder LM of every family (``model``),
its layers (``layers``), the MoE FFN (``moe``), the Mamba-2 block
(``ssm``), the config (``config``) and the JAX parameter bridge
(``convert``)."""
