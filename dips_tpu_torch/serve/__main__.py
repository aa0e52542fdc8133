from .daemon import main

raise SystemExit(main())
