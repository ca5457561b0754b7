"""Distill serving plane of the port: the teacher server and the predict
functions it serves."""
