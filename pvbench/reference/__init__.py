"""The plain float64 reference (pv64.py), independent of the program."""
