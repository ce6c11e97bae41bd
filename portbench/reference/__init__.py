"""The plain reference that decides `correct`

Plain PyTorch and numpy, in float32 with TF32 off (`exact`), or with
every model operand rounded to scaled float8 (`Float8`), the control.
It imports neither JAX nor the JAX package nor `promonet_tpu_torch`:
each module is a frozen copy of the port's plain path at commit
ce32675, with the file it came from named in its docstring. It takes
the weights and inputs that the harness made, never a table or a
packed weight the program made.
"""
