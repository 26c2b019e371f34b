"""One reader per metric, found by the metric's name in BENCHMARK.json.

A reader module may declare what it needs from a run: `SPANS` ({label:
["module:attribute", ...]}) and `CALLS` ({label: (["module:attribute"],
args_fn)}) set from `vobench/spans.py` on the program's functions in a
traced run, `TRACE = True` for the device trace, `SYNCS = True` for the
count of the program's synchronising calls. Its `read(run)` takes the
harness's `RunRecord` and returns the value, a dict with "value" and further
keys, or None where the run holds nothing to read.
"""
