"""gpubench: the benchmark of nat_tpu_torch, the PyTorch/CUDA tokenizer.

``python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell once (see ``README.md``).  Everything that decides a number
lives here: traffic, span and FLOP arithmetic, the table of peaks, the
trace reduction, the plain float32 reference and the comparison that sets
``correct``.  From the program the harness takes only the system under test
and its spans, counters and kernel names.
"""
