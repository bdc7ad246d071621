"""Set-up: process start to the first timed step, s (the harness
measures it)."""


def read(q):
    return q["setup_s"]
