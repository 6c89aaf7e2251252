"""ft_ms: device ms per replay of the fleet's graph FT (the first CUDA graph
launch of each DeviceVOFleet.step in the traced window), its kernels'
summed time; every replay must show the same count of device events."""

from benchmark.metrics import graph_ms


def read(run):
    return graph_ms(run, 0)
