"""Training of the port's LM (counterpart of ``repro.train``): AdamW with
optional int8 states (``optimizer``), error-feedback gradient compression
(``compression``) and the train step (``train_step``)."""
