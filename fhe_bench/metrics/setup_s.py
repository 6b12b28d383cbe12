"""Seconds from the process's start to its first timed request."""


def read(r):
    return r.setup_s
