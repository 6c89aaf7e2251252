"""fp_ms: device ms per replay of the fleet's graph FP (the second CUDA
graph launch of a DeviceVOFleet.step, on ticks where some stream
promotes), held to its graph's events as ft_ms is."""

from benchmark.metrics import graph_ms


def read(run):
    return graph_ms(run, 1)
