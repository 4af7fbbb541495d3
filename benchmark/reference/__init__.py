"""The plain reference: the published U-Net, its MC summary and eval rows,
and its first training steps, in plain PyTorch float32. It imports
nothing of the program and takes nothing the program made."""
