"""Model code of the port: config, capability gate, parameters, layers,
attention, blocks and model assembly."""
