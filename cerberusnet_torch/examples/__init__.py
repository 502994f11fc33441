"""The JAX package's examples, ported: ``video_stream`` (the real-time
serving loop with pipelined uploads), ``raft_anytime_inference`` (one
weight-tied RAFT state at any iteration count), ``demo_end_to_end`` (fit,
evaluate, a panel, an export) and ``migrate_from_torch`` (a
``TorchCerberus`` checkpoint imported, evaluated, used and exported).
Each runs as ``python -m cerberusnet_torch.examples.<name>``, on the card
unless ``--device cpu`` is given."""
