"""One file per model family: weights and inputs drawn from the seed, the
step's FLOPs, the stand-ins (``KINDS``, ``standin``) and the tiny CPU
configuration (``tiny``); a configuration file names its family."""
