"""Generic name -> (constructor, params, aliases) registry.

Counterpart of the reference's factory framework
(/root/reference/base/PyNucleus_base/factory.py:11).
"""


class factory:
    def __init__(self):
        self.classes = {}
        self.aliases = {}

    def getCanonicalName(self, name):
        if isinstance(name, str):
            name = name.lower()
        if name in self.aliases:
            return self.aliases[name]
        return name

    def register(self, name, classType, params=None, aliases=None):
        canonical = name.lower() if isinstance(name, str) else name
        self.classes[canonical] = (name, classType, params if params else {})
        if aliases:
            for a in aliases:
                self.aliases[a.lower() if isinstance(a, str) else a] = canonical

    def isRegistered(self, name):
        return self.getCanonicalName(name) in self.classes

    def build(self, name, *args, **kwargs):
        canonical = self.getCanonicalName(name)
        if canonical not in self.classes:
            raise KeyError(
                f"'{name}' not registered; available: {sorted(self.classes)}")
        _, classType, params = self.classes[canonical]
        merged = dict(params)
        merged.update(kwargs)
        return classType(*args, **merged)

    def __call__(self, name, *args, **kwargs):
        return self.build(name, *args, **kwargs)

    def numRegistered(self):
        return len(self.classes)

    def __str__(self):
        return "\n".join(
            f"{name}: {cls}" for name, (n, cls, p) in sorted(self.classes.items()))

    def __repr__(self):
        return f"factory({sorted(self.classes)})"
