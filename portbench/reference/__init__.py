"""The plain float64 reference the benchmark checks the program against."""
