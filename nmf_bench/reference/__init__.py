"""The plain reference of the benchmark: PyTorch and NumPy alone.

Nothing here imports the program, nor JAX. It restates from the reference
pyDNMFk (and the program's documented seeding rules) what the program
computes, and it takes only the inputs that the benchmark made: never a
weight, a member or a factor that the program produced, except to judge it.
"""
