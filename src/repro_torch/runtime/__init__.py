"""The trainer's runtime: the step watchdog (``straggler``) and the
remesh plan after device losses (``elastic``); counterpart of
``repro.runtime``."""
