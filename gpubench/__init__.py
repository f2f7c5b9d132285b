"""The benchmark of the PyTorch and CUDA port (mitsuba2_tpu_torch).

`python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once. The harness is
driven by data: a configuration is gpubench/configs/<name>.json, a
traffic mix gpubench/workloads/<cell>.json, a per-layer metric
gpubench/metrics/<metric>.py, and the plain reference that decides
`correct` is gpubench/reference/.
"""
