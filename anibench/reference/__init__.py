"""Plain references, one module a method (``reference/<method>.py``):
``compute(paths, pairs, device, params, dtype)`` gives the row each
ordered pair (query index, subject index) should have, from the FASTA
files alone. They import nothing of the program."""
