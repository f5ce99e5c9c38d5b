"""Solvers: the eigen_s facade, divide & conquer and the back-transform
(counterpart of ``eigenexa_tpu/solvers``)."""
