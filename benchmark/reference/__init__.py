"""Plain references the check holds the program's answers against."""
