"""Host data layer: the depth encoders and the SUNRGBD row reader, and the
port's copies of the JAX package's anyres packing, chat templates,
tokenization, image processing, collation and loader."""
