"""The benchmark's own machinery: cells by name, traffic, weights, the served
system, the window, the trace, the work count and the comparison."""
