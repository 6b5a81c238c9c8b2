"""The corpus-sharded FM-index and its constrained decoder (counterpart of
``seal_tpu/parallel/sharded_index.py`` and ``sharded_decode.py``), with
every shard stacked on one card."""
