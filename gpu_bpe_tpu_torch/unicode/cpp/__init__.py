"""Sources of the native Unicode decoder and its build."""
