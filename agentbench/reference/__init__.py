"""The benchmark's plain reference (float32, plain torch; imports nothing of
the program)."""
