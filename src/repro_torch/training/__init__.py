"""Training for the port: the synthetic data stream (``data``), AdamW with
global-norm clipping and optional bf16 gradient compression
(``optimizer``), and the train step (``train_step``), the counterparts of
``repro.training``. Params are the master tree of ``repro_torch.weights``
(the reference's layout, float32); the moments mirror it leaf for leaf."""
