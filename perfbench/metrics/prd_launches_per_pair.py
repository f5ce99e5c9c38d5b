"""prd_launches_per_pair: device kernels launched inside the program's
``prd.pair`` spans (in the pair or in its sub-spans; copies and sets not
counted, as ``kernels_per_solve``) ÷ the number of those spans, in the
annotated solve of ``spantrace.collect``.  A fused pair kernel lowers it;
CUDA graphs leave it as it is."""

from perfbench import devtrace, spantrace


def read(rec):
    trace = spantrace.collect(rec)
    if not trace:
        return None
    count = spantrace.span_count(trace, "prd.pair")
    if not count:
        return None
    ops = spantrace.ops_within(trace, "prd.pair")
    return sum(devtrace.is_kernel(op[0]) for op in ops) / count
