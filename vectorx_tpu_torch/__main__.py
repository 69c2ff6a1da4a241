import sys

from .services.entrypoint import main

sys.exit(main())
