"""setup_s: seconds from the start of the process to the first timed solve:
imports, the card's context, the kernels' build or load, the input and one
warm solve."""


def read(rec):
    return rec["setup_s"]
