"""Plain PyTorch reference of the edit and of midu training. It imports
nothing of the program under test (``rgie_tpu_torch``), of its JAX original
or of JAX."""
