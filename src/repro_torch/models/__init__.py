"""The decoder LM of the port: configs, layers, attention, the model."""
