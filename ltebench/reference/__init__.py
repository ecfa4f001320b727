"""The plain reference that decides `correct`: the PDSCH link from 3GPP TS
36.211 and 36.212 in plain PyTorch and numpy (link.py, tables.py) and a
frozen copy of the stated turbo decoder's rules (turbo.py).  It imports
neither JAX, the JAX package nor anything of the program, and takes
nothing that the program made but the outputs it judges.
"""
