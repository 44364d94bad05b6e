"""The plain float32 reference of the tokenizer, and the control."""
