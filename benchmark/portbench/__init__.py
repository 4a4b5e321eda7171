"""The benchmark harness of ``openvivqa_tpu_torch`` on one NVIDIA H100.

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, kind of traffic, generator,
per-layer metric or kernel entry sits in a file of its own that the harness
finds by name; the shared code (``portbench/``) reads no key of any one
configuration:

  benchmark/configs/<config>.json       the configuration as it is run
  benchmark/traffic/<mix>.json          a traffic mix; its "kind" and its
                                        "generator" name ...
  benchmark/kinds/<kind>.py             ... the code that drives the entry, its
                                        comparison with the reference and its
                                        controls (``run``, ``control_readings``)
  benchmark/data/<generator>.py         ... the code that writes the split from
                                        the mix and the seed (``generate``,
                                        ``config_keys``)
  benchmark/reference/<config>.py       a configuration's plain reference, its
                                        split reader and its FLOP shapes
  benchmark/work/models/<config>.py     a configuration's model FLOPs
  benchmark/metrics/<metric>.py         a per-layer metric's reader, or
  benchmark/metrics/<quantity>.py       the one of every split of a quantity
                                        (``mfu`` serves ``mfu.train``, ``mfu.eval``)
  benchmark/work/entries/<entry>.py     a kernel entry's operations and bytes
  benchmark/limits/<cell>.json          the limits that decide `correct`
"""
