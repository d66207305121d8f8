"""Device meshes: the pair grid split across devices (``mesh``), and the
multi-device dry run of the pipeline's three sharded steps
(``multichip``)."""
