"""Host-side helpers: CSV IO, the GCC-exact RNG, report formatting, the nvcc build."""
