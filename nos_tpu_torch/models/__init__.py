"""The Llama model family: model, weight conversion, generation."""
