"""Signal processing, masking and the kernel wrappers of the port."""
