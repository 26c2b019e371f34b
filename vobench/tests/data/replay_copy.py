"""A made-up traffic driver for the harness's tests: `Replay` under another
name, found by name as a new driver file is."""

from vobench.drivers import Replay


class Driver(Replay):
    pass
