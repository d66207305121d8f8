"""The demo CLI of the port: ``python -m roman_tpu_torch.demo -p <params>
-o <out>`` maps, aligns and solves as demo/demo.py does; ``main(argv)``
runs it in-process."""

from roman_tpu_torch.demo.demo import main  # noqa: F401
