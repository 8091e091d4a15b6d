"""Core of the port: projection, grid index, Eq.-1 loop, candidate stage."""
