"""Plain PyTorch references of what the benchmark's cells compute. They
import neither JAX, the JAX package nor anything of the system under test,
and take nothing it made: the benchmark hands both sides the same seeded
weights and inputs, and the reference works out the rest again."""
