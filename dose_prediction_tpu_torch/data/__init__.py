"""Data path (counterpart of dose_prediction_tpu/data/): NIfTI and OpenKBP
loading, augmentation, the native reader, the batch builders, the packed
feed and the pinned-memory prefetch onto the card."""
