"""tpudist_torch.serve — the port's serving plane.

- ``serve.export``   — arch name → eval-mode model in the compute dtype on
  the device (fresh weights from ``--seed``), ``--flash on|off``;
- ``serve.engine``   — ``ServeEngine``: one warm-up forward per bucket,
  then bucket-padded inference returning host f32 logits;
- ``serve.batching`` — ``ContinuousBatcher`` and the open-loop load
  generator, the same scheme and events as ``tpudist.serve.batching``.

CLI: ``python -m tpudist_torch.serve`` (see ``serve/__main__.py``).
"""
