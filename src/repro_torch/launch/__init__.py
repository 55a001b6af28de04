"""Launch drivers of the port: the prefill and serve steps and the
serving loop (``serve.py``). Training waits for a later slice."""
