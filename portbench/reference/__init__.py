"""The plain reference the benchmark judges the port's answers by."""
