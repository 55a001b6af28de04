"""Launch drivers of the port: the prefill and serve steps, the serving
loop (``serve.py``) and the sweep CLI (``sweep.py``). Training waits for
a later slice."""
