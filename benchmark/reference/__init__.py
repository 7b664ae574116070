"""The benchmark's plain reference of the codec: plain PyTorch in fp32, a
frozen copy of the model's math, written against the parameter names of
the model's ``state_dict``. It imports nothing of the program, runs no
hand-written kernel, and works out its own decoded picture buffer. The
benchmark hands it the weights and inputs it drew, never anything the
program derived from them."""
