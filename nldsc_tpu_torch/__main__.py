"""``python -m nldsc_tpu_torch`` — CLI entry."""

from .cli import main

if __name__ == "__main__":
    main()
