"""idle_in_program_pct: the share of the traced window in which no program
operation ran on the card while the host was inside a root span of a
traced batch's request (progspans.py). What device_idle_pct holds beyond
it passed while the host was in the harness or between requests."""

from portbench import progspans


def read(run):
    m = progspans.mapped(run)
    return None if m is None else m.idle_in_program_pct()
