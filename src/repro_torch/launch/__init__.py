"""Launch drivers of the port: the train, prefill and serve steps
(``steps.py``), the train driver (``train.py``), the serving loop
(``serve.py``), the sweep CLI (``sweep.py``), meshes over
``torch.distributed`` (``mesh.py``), the sharding rules
(``sharding.py``) and the assigned input shapes (``shapes.py``)."""
