"""Model stack of the port: layers, attention and the dense LM (serving)."""
