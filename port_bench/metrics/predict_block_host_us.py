"""predict_block_host_us: the host's time for one block of a predict call
(featurize, the readout index, the readout), in us: the median of the
program's ``predict.block`` timer over its sample buffer (the traced
window's newest 4096 blocks)."""
from port_bench.metrics.pcg_host_us import samples_median


def read(run):
    return samples_median("predict.block")
