"""Model configurations of the dense llama-family architectures."""
