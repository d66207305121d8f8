"""``python -m roman_tpu_torch.demo``: see roman_tpu_torch.demo.demo."""

from roman_tpu_torch.demo.demo import main

if __name__ == "__main__":
    main()
