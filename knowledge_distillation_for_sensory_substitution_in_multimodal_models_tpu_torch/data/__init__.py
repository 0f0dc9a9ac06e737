"""Host data layer: the jax-free depth encoders and the SUNRGBD row reader.

Anyres packing, chat templates, tokenization and collation are imported
from the JAX package, which keeps them free of jax."""
