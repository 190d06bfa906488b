"""The plain f32 reference the benchmark holds the program to."""
