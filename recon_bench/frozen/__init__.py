"""Frozen copies that the benchmark holds the program to: the input
generator (``inputs``) and the plain reference (``reference``). Neither
imports the program, JAX or the JAX package; later changes to the program
cannot move them."""
