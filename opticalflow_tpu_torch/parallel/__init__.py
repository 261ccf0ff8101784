"""Multi-GPU runs on ``torch.distributed``: one process per card.

Counterpart of ``opticalflow_tpu.parallel``.  :mod:`.mesh` holds the
process group and the data-parallel helpers (``make_mesh``,
``resolve_data_parallel``, ``shard_batch``, ``replicate``, ...);
:mod:`.spatial` the tiled and halo-exchange inference of very large frames.
"""
