"""Plain NumPy / PyTorch references the benchmark judges the program's
answers with; they import nothing of the program."""
