"""The data layer: the image decode (PNG in ``png.py``), the class index
and splits (``datasets.py``), the flat uint8 store and its mmap cache
(``preprocess.py``), episode sampling (``episodes.py``) and the threaded
episodic loader of the three tiers (``loader.py``). Numpy only: no tensor
is made here."""
