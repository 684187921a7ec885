"""Plain references the comparison holds the program to."""
