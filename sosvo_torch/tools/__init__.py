"""Measurement scripts for the port on a CUDA card, and the workloads they share.

Each script runs from the repository root as `python -m sosvo_torch.tools.<name>`
and needs a CUDA device; none falls back to the CPU. PERF.md names the script
beside each figure it produced.
"""
