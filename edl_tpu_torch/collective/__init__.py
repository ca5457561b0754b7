"""Job-environment contract of the port (the trainer's half)."""
