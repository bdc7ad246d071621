"""Host seconds of the port's own set-up calls (graph building, schedule,
prepare_data, plan), from the benchmark's spans around them."""

from hgnnbench import readers


def read(r):
    return readers.spans_total(r, "bench/setup/")
