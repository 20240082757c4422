"""``python -m s2i_tpu_torch``: see :mod:`s2i_tpu_torch.entrypoints`."""

from s2i_tpu_torch.entrypoints import main

if __name__ == "__main__":
    main()
