"""Quality evaluation of the registration engine: the adversarial sweep
(``python -m roman_tpu_torch.eval.adversarial``) and the serial numpy
referee it is held against (``np_referee``)."""
