"""The optimizer of the training slice: AdamW and gradient compression on
trees of tensors (``repro.optim`` counterparts)."""
