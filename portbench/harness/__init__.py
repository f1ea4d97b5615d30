"""The harness: files found by name, weights and inputs from the seed, the
entries the window drives, the trace reader and the comparison."""
