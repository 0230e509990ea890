"""Share of the device's idle time in the traced window, in percent, that
no span below a batch's root names (``lakebench/hostspans.py``): the
host's work between batches and the harness's own client work. Logs the
idle seconds by span label to standard error."""
from lakebench import hostspans


def read(run):
    att = hostspans.attribute(run)
    if att is None or att["idle_s"] <= 0:
        return None
    hostspans.log_table(att)
    return 100.0 * att["unattributed_s"] / att["idle_s"]
