"""The live observability plane of the port (tpudist's ``obs/``):

- ``obs.server``    the per-rank Prometheus endpoint (``--metrics-port``),
                    a sink of the telemetry stream, and the launcher's
                    fleet view (heartbeats, straggler flags, the ranks'
                    scraped headlines);
- ``obs.tsdb``      the fleet's time series, one row a supervision poll;
- ``obs.dashboard`` the launcher's ``/dashboard`` HTML page.

Host code: it imports no torch, so the launcher and the tests use it
without a card. tpudist's ``obs/trace.py`` (the merged Perfetto export)
and ``obs/xla_introspect.py`` are not ported.
"""
