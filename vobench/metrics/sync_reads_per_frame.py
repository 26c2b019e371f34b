"""The host's reads of the card per frame, as the program counts them at
each read (`sync.<site>` counters) inside the traced window, over the frames
stepped in it; keys: each site's reads per frame, which sum to the value.
`sync.live_wait` and `sync.live_upload` are waits on CUDA events, which
PyTorch's sync debug mode does not see; the other sites are the reads
`host_syncs_per_frame` counts."""

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    sites = w.counts("sync.")
    return {"value": sum(sites.values()) / w.frames,
            **{k: n / w.frames for k, n in sorted(sites.items())}}
