"""solve_s: the window's wall seconds, from the start of its first solve to
the end of its last, over the solves it completed (host clock; each solve
ends in a device barrier)."""


def read(rec):
    return rec["window_s"] / rec["solves"]
