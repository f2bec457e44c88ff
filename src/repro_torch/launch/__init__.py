"""Entry points of the port: the serving loop and its step builders."""
