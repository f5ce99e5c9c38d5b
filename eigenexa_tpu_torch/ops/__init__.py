"""Householder reduction, secular merges and the hand-written kernels'
wrappers (counterpart of ``eigenexa_tpu/ops``)."""
