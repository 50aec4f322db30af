"""Plain float32 references that decide ``correct``; they import nothing of the program."""
