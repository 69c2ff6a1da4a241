"""The plain side of the benchmark's comparison: hashlib, Python ints and
numpy. It imports nothing of the program, of JAX or of the JAX package
(a test holds it to that), and is handed the inputs the benchmark made
and the outputs the program produced."""
