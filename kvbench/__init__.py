"""The port's serving benchmark: ``repro_torch`` disaggregated on one card,
driven by an open-loop arrival schedule.

Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model configuration as run, with its CPU
  test size and limits (``test``);
- ``traffic/<mix>.json``: the parameters the one generator (``traffic.py``)
  reads;
- ``cells/<workload>.json``: the cell's offered rate, lead, slabs, latency
  limits and correctness limit;
- ``metrics/<metric>.py``: one metric's reader (``read(run) -> float | None``);
- ``reference/<name>.py``: a plain float32 PyTorch decoder, with, where the
  harness's defaults do not hold for its configuration, its own
  ``weight_rule`` and FLOP counts (``weights.py``, ``flops.py``).

Run one cell with ``python3 kvbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.
"""
