"""The Llama family: model, weight conversion, generation, training and
checkpoints."""
