"""The harness of the port's benchmark: cell discovery, traffic, the window, the trace, the check."""
