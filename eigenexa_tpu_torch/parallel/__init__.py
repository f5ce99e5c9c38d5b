"""The distributed layer: the process mesh, its layouts and collectives,
the distributed reduction and back-transform, and the distributed drivers
(counterpart of ``eigenexa_tpu/parallel``; reference: comm.F and
eigen_libs0.F, SURVEY.md §1)."""
