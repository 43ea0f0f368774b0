"""Meshes and several processes on torch.distributed (counterpart of
dose_prediction_tpu/parallel): ``mesh`` (axes, sharding rules,
``shard_params``), ``multihost`` (joining processes), ``collectives`` (the
all-reduces GSPMD would insert) and ``sharded`` (the modules that compute on
split leaves)."""
