"""Traffic: the generators (``tokens.py``, ``requests.py``) and the mixes they
read (``<traffic>.json``, named by a cell's ``traffic``)."""
